"""Banded Smith-Waterman seed extension: dispatch and plain reference.

`bsw_desc_ref` is the plain PyTorch version of the extension kernel
(behavioral spec: bandedSWA.cpp:116-237 == ksw_extend2): the descriptor
form of bwamem2_tpu's `bsw_desc_kernel` + `_bsw_dp`, vectorized ACROSS
PAIRS (one row of the (P, Qmax+1) grids per extension problem), int32
throughout.  Every control-flow branch of the scalar kernel is a mask:
adaptive band [beg, end) with the post-row shrink-to-nonzero scan, per-row
max with the rightmost-tie rule, z-drop and row-max==0 termination,
end-bonus gscore tracking.  The only intra-row dependency, the F (gap in
query) running max, unrolls to a prefix-max with linear decay,
  f[j] = max_{j'<j} (relu(M[j'] - oe_ins) + j'*e_ins) - (j-1)*e_ins,
computed with torch.cummax.  H keeps the scalar kernel's column-shifted
storage (H[j] = H(i-1, j-1) entering a row), so outputs are identical to
the scalar kernel, the JAX kernels and the CUDA kernel (tested).

`bsw_shear_desc_ref` is the plain version of the long-pair kernel
(bwamem2_tpu's `bsw_shear_desc_kernel` / `_bsw_shear_dp`): the same rows,
but the DP state is a frame of 2*Wh+3 band offsets that moves one
column per row, so a row costs O(w) instead of O(qlen).

Two dispatches, the same kernels:
  * `DeviceBSW.run_arrays`, called by the native extension stage
    (hostrt.extension_batch, the flat path): every pair is in-cap;
  * `DeviceBSW.left_kernel` / `right_kernel`, the object path
    (align/extend.py:extend_chains, for chunks the flat path does not
    take: long reads): in-cap pairs as above, longer ones in one call of
    `bsw_shear_cuda.bsw_shear` (`DeviceBSW.long_order`), and
    the pairs of a read the read grid does not hold to the native host
    kernel, counted as `overflow.bsw_host_tail`.
In-cap pairs split over the fixed (Q, T) shape ladder and every rung group
goes, longest pairs first, to `bsw_cuda.bsw_extend`.  Each wrapper runs
its CUDA kernel for a read grid on the GPU and its plain version for one on
the CPU, and all launches are enqueued before one fetch.

The tile forms pass materialized (q, t) tiles to the same kernels as
descriptors (`_tile_descriptors`): `bsw_tiles` to `bsw_extend`
(bwamem2_tpu's `bsw_kernel`, the seed-extend step's), `bsw_shear_tiles`
to `bsw_shear` (its `bsw_shear_kernel`, called by tools/kernel_micro.py).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .device_index import take_ref

I32 = torch.int32
NEG_BIG = -(1 << 30)

# the in-cap class (bsw_extend); longer pairs are the long class
QCAP, TCAP = 256, 608
# long class (pacbio/ont2d): pairs beyond (QCAP, TCAP) with qlen up to this
# run on the sheared-band kernel; rows stop at min(tlen, qlen + w + 2) (the
# first empty-band row ends the pair), so tlen needs no cap
LONG_QCAP = 32768
# the JAX package's row rungs of the long class (its static T shapes); the
# port gives a call's long pairs to bsw_shear at once (DeviceBSW.
# long_order), and the tests split them by these rungs to hold that
# against per-rung calls
LONG_T_LADDER = (768, 1536, 3072, 6144, 12288, 24576, LONG_QCAP + 512)


def long_rows(qls: np.ndarray, tls: np.ndarray, w: int) -> np.ndarray:
    """The rows a long pair can run, min(tlen, qlen + w + 2): a pair stops
    at its first empty band, by row qlen + w."""
    return np.minimum(np.asarray(tls, np.int64),
                      np.asarray(qls, np.int64) + w + 2)


def long_classes(qls: np.ndarray, tls: np.ndarray, idxs, w: int) -> list:
    """(T, idx_array) groups of the JAX package's sheared long class,
    keyed by the effective row count min(tlen, qlen + w + 2): rows past
    the last possible in-band row never run, so a tlen >> qlen pair is
    cheap.  T caps the rung's rows; the frame does not depend on qlen, so
    no query rung is needed."""
    idxs = np.asarray(idxs)
    eff = long_rows(qls[idxs], tls[idxs], w)
    rung = np.searchsorted(LONG_T_LADDER, eff)
    out = []
    for r in range(len(LONG_T_LADDER) + 1):
        sel = idxs[rung == r]
        if not len(sel):
            continue
        if r < len(LONG_T_LADDER):
            T = LONG_T_LADDER[r]
        else:
            # a huge -w can push eff past the top rung: one rung sized to
            # the group (1024-quantized)
            T = int(-(-int(eff[rung == r].max()) // 1024)) * 1024
        out.append((T, sel))
    return out


def t_classes(qls: np.ndarray, tls: np.ndarray, idxs) -> list:
    """Split pair indices across the fixed (Q, T) shape ladders
    (sortPairsLenExt analog): per-T-rung groups, tiny groups merged
    upward so no dispatch runs nearly empty.  Returns [(Q, T, idx_array)]."""
    idxs = np.asarray(idxs)
    ladder = (96, 160, 224, 320, 448, TCAP)
    rung = np.searchsorted(ladder, tls[idxs])
    groups = []
    for r in range(len(ladder)):
        sel = idxs[rung == r]
        if len(sel):
            groups.append((r, sel))
    merged = []
    cur: list = []
    for i, (r, sel) in enumerate(groups):
        cur.append(sel)
        if sum(len(x) for x in cur) >= 256 or i == len(groups) - 1:
            merged.append((r, np.concatenate(cur)))
            cur = []
    out = []
    for r, sel in merged:
        qmax = int(qls[sel].max())
        Q = 127 if qmax <= 127 else 255 if qmax <= 255 else 383
        out.append((Q, ladder[r], sel))
    return out


def bsw_desc_ref(ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0, w_in,
                 Qmax: int, Tmax: int, mat_a: int, mat_b: int,
                 o_del: int, e_del: int, o_ins: int, e_ins: int,
                 zdrop: int, end_bonus: int, max_sc: int,
                 ref_packed: bool = False, cells: list | None = None
                 ) -> torch.Tensor:
    """Banded SW extension of P pairs given by DESCRIPTORS (plain PyTorch).

    ref: uint8 doubled genome (2-bit packed if ref_packed); enc: int8[N, L]
    padded read grid.  Per pair (int32[P] unless noted): qoff = flat
    row*L+col start in enc, qdir = +-1 walk, qlen <= Qmax; toff (int64) =
    absolute start in ref, tdir = +-1, tlen <= Tmax; h0 start score; w_in
    band width.  Returns int32[P, 6]: score qle tle gtle gscore max_off.
    If `cells` is a list, the number of DP cells the band covered over the
    rows that ran (the work the CUDA kernel does) is appended to it."""
    dev = enc.device
    N, L = enc.shape
    P = qoff.shape[0]
    enc_flat = enc.reshape(-1).to(I32)
    jidx = torch.arange(Qmax, dtype=I32, device=dev)[None, :]
    qpos = qoff[:, None].long() + qdir[:, None].long() * jidx
    q = torch.where(jidx < qlen[:, None],
                    enc_flat[qpos.clamp(0, N * L - 1)], 4)
    iidx = torch.arange(Tmax, dtype=torch.int64, device=dev)[None, :]
    tpos = toff[:, None] + tdir[:, None].long() * iidx
    t = torch.where(iidx < tlen[:, None], take_ref(ref, tpos, ref_packed), 4)

    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    cols = torch.arange(Qmax + 1, dtype=I32, device=dev)[None, :]
    qcols = torch.cat([q, torch.full((P, 1), 4, dtype=I32, device=dev)], 1)
    colsm1 = (cols - 1).clamp(min=0) * e_ins

    # first row: H[j] = max(h0 - oe_ins - (j-1)*e_ins, 0), H[0] = h0
    tj = h0[:, None] - oe_ins - (cols - 1) * e_ins
    H = torch.where(cols == 0, h0[:, None], tj.clamp(min=0))
    H = torch.where(cols <= qlen[:, None], H, 0)
    E = torch.zeros_like(H)

    # clamp the band in float64 (bandedSWA.cpp:147-156)
    max_ins = ((qlen * max_sc + end_bonus - o_ins).double() / e_ins
               + 1.0).floor().to(I32)
    max_del = ((qlen * max_sc + end_bonus - o_del).double() / e_del
               + 1.0).floor().to(I32)
    w = torch.minimum(w_in, max_ins.clamp(min=1))
    w = torch.minimum(w, max_del.clamp(min=1))

    mx = h0.to(I32)
    max_i = torch.full((P,), -1, dtype=I32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros((P,), dtype=I32, device=dev)
    beg = torch.zeros((P,), dtype=I32, device=dev)
    end = qlen.to(I32)
    done = tlen <= 0
    n_cells = torch.zeros((), dtype=torch.int64, device=dev)
    neg_col = torch.full((P, 1), NEG_BIG, dtype=I32, device=dev)

    for i in range(Tmax):
        act = ~done & (i < tlen)
        if i % 16 == 0 and not bool(act.any()):
            break      # every lane finished (the scalar loop's early exit)
        beg_r = torch.maximum(beg, i - w)
        end_r = torch.minimum(torch.minimum(end, i + w + 1), qlen)
        if cells is not None:
            n_cells += torch.where(act, (end_r - beg_r).clamp(min=0),
                                   0).sum()
        ti = t[:, i:i + 1]
        h1_0 = torch.where(beg_r == 0,
                           (h0 - (o_del + e_del * (i + 1))).clamp(min=0), 0)

        band = (cols >= beg_r[:, None]) & (cols < end_r[:, None])
        s_ij = torch.where((ti >= 4) | (qcols >= 4), -1,
                           (ti == qcols).to(I32) * (mat_a + mat_b) - mat_b)
        # M[j] = diagonal input: the column-shifted H slot (+ score)
        Mv = torch.where(H != 0, H + s_ij, 0)
        u = torch.where(band, (Mv - oe_ins).clamp(min=0) + cols * e_ins,
                        NEG_BIG)
        upre = torch.cat([neg_col, torch.cummax(u, 1).values[:, :-1]], 1)
        fv = upre - colsm1
        hv = torch.maximum(torch.maximum(Mv, E), fv)
        hv = torch.where(band, hv, 0)
        # row max with the rightmost-tie rule
        m = hv.max(1).values
        mj = torch.where(band & (hv == m[:, None]), cols, -1).max(1).values
        # h1 entering column j is hv[j-1] (h1_0 at the band start)
        carry = torch.cat([h1_0[:, None], hv[:, :-1]], 1)
        carry = torch.where(cols == beg_r[:, None], h1_0[:, None], carry)
        h1_end = torch.where(
            end_r > beg_r,
            hv.gather(1, (end_r - 1).clamp(min=0)[:, None].long())[:, 0],
            h1_0)
        wr = act[:, None] & band
        H = torch.where(wr, carry, H)
        E = torch.where(wr, torch.maximum(E - e_del,
                                          (Mv - oe_del).clamp(min=0)), E)
        # eh[end].h = h1; eh[end].e = 0
        at_end = act[:, None] & (cols == end_r[:, None])
        H = torch.where(at_end, h1_end[:, None], H)
        E = torch.where(at_end, 0, E)

        # gscore bookkeeping when the row spans the full query
        full = act & (end_r == qlen)
        max_ie = torch.where(full & (gscore <= h1_end), i, max_ie)
        gscore = torch.where(full, torch.maximum(gscore, h1_end), gscore)
        m = torch.where(act, m, 0)
        mj = torch.where(act & (m > 0), mj, -1)

        # termination + max update + zdrop
        newly_done = act & (m == 0)
        upd = act & (m > mx)
        max_off = torch.where(upd, torch.maximum(max_off, (mj - i).abs()),
                              max_off)
        if zdrop > 0:
            di = i - max_i
            dj = mj - max_j
            zd = torch.where(di > dj, mx - m - (di - dj) * e_del > zdrop,
                             mx - m - (dj - di) * e_ins > zdrop)
            newly_done = newly_done | (act & ~upd & (m != 0) & zd)
        mx = torch.where(upd, m, mx)
        max_i = torch.where(upd, i, max_i)
        max_j = torch.where(upd, mj, max_j)

        # band shrink to the nonzero region (bandedSWA.cpp:218-221)
        nz = (H != 0) | (E != 0)
        first = torch.where(band & nz, cols, Qmax + 2).min(1).values
        beg_n = torch.minimum(first, end_r)
        inB = (cols >= beg_r[:, None]) & (cols <= end_r[:, None]) & nz
        last = torch.where(inB, cols, beg_r[:, None] - 1).max(1).values
        end_n = torch.minimum(last + 2, qlen)

        keep = act & ~newly_done
        beg = torch.where(keep, beg_n, beg_r)
        end = torch.where(keep, end_n, end_r)
        done = done | newly_done
    if cells is not None:
        cells.append(int(n_cells))
    return torch.stack([mx, max_j + 1, max_i + 1, max_ie + 1, gscore,
                        max_off], 1)


def bsw_shear_desc_ref(ref, enc, qoff, qdir, qlen, toff, tdir, tlen, h0,
                       w_in, Wh: int, Tmax: int, mat_a: int, mat_b: int,
                       o_del: int, e_del: int, o_ins: int, e_ins: int,
                       zdrop: int, end_bonus: int, max_sc: int,
                       ref_packed: bool = False,
                       cells: list | None = None) -> torch.Tensor:
    """Sheared-band extension of P long pairs given by descriptors (plain
    PyTorch): the same inputs, outputs and `cells` as bsw_desc_ref, whose
    rows it computes over a frame of band offsets instead of the whole
    query.  Wh must be at least every pair's w.

    The frame has F = 2*Wh + 3 slots: slot u at row i holds query column
    j = i - Wh - 1 + u, so the band [i - w, i + w] and its end slot lie in
    slots 1 .. 2*Wh + 2.  The shear turns the diagonal (i-1, j-1) -> (i, j)
    into a vertical step: bsw_desc_ref's column-shifted H (H[j] = H(i-1,
    j-1)) keeps its slot from row to row, while E and every cell the row
    does not write move one slot left; the slot entering at u = F-1 holds
    its column's row-0 value, which no row can have overwritten (row i
    writes up to column i + w + 1).

    Only live pairs are stepped: after a row in which a pair stops (on
    z-drop, on a zero row maximum or after its last row, at the latest at
    row qlen + w, where its band is empty), its results are final and the
    state is cut to the others.  So no row needs a liveness mask, and rows
    end when no pair is live, as the JAX kernel's while_loop does.  A
    row's ops are small, so its cost is mostly their count: what does not
    change along a row is hoisted (the target codes of 64 rows at a time)
    or skipped once it is 0 for every pair (the entering column's row-0
    H, h1 at column 0)."""
    dev = enc.device
    N, L = enc.shape
    P = qoff.shape[0]
    F = 2 * Wh + 3
    qlen = qlen.to(I32)
    Qb = int(qlen.max()) if P else 0
    # the row-i query window is qwin[:, i - q0:i - q0 + F] (slot u: column
    # i-Wh-1+u) as score-table indices: 0-3 bases, 4 ambiguous or past the
    # query, 5 a negative code
    jidx = torch.arange(Qb, dtype=torch.int64, device=dev)[None, :]
    qpos = qoff[:, None].long() + qdir[:, None].long() * jidx
    q = enc.reshape(-1)[qpos.clamp(0, N * L - 1)].long()
    q = torch.where(jidx < qlen[:, None],
                    torch.where(q < 0, 5, q.clamp(max=4)), 4)
    pad = lambda k: torch.full((P, k), 4, dtype=torch.int64,  # noqa: E731
                               device=dev)
    qwin = torch.cat([pad(Wh + 1), q, pad(F + 8)], 1)
    q0 = 0
    del q, qpos
    # score of target code t (0-3 bases, 4 anything else) vs. query index
    # k, at tab[6 * t + k]
    tab = torch.full((5, 6), -mat_b, dtype=I32, device=dev)
    tab[torch.arange(4), torch.arange(4)] = mat_a
    tab[4, :] = -1
    tab[:, 4] = -1
    tab = tab.reshape(-1)

    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    us = torch.arange(F, dtype=I32, device=dev)[None, :]
    h0i = h0.to(I32)
    # row-0 H (bandedSWA.cpp:139-146): h0 at column 0, decaying, 0 past qlen
    j = us - (Wh + 1)
    H = torch.where(j == 0, h0i[:, None],
                    (h0i[:, None] - oe_ins - (j - 1) * e_ins).clamp(min=0))
    H = torch.where((j >= 0) & (j <= qlen[:, None]), H, 0)
    E = torch.zeros((P, F), dtype=I32, device=dev)
    Hn, En = torch.empty_like(H), torch.empty_like(E)
    # the row-0 H of the column entering after row i (column i + Wh + 2):
    # hent - i * e_ins while positive and the column is in the query
    hent = h0i - oe_ins - (Wh + 1) * e_ins
    n_ent = int(hent.max()) // e_ins + 1 if P else 0

    # clamp the band in float64 (bandedSWA.cpp:147-156)
    max_ins = ((qlen * max_sc + end_bonus - o_ins).double() / e_ins
               + 1.0).floor().to(I32)
    max_del = ((qlen * max_sc + end_bonus - o_del).double() / e_del
               + 1.0).floor().to(I32)
    w = torch.minimum(w_in.to(I32), max_ins.clamp(min=1))
    w = torch.minimum(w, max_del.clamp(min=1))
    w1 = w + 1
    wmax = int(w.max()) if P else 0

    mx = h0i.clone()
    max_i = torch.full((P,), -1, dtype=I32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros((P,), dtype=I32, device=dev)
    beg = torch.zeros((P,), dtype=I32, device=dev)
    end = qlen.clone()
    tlen = tlen.to(I32)
    toff, tdir = toff.long()[:, None], tdir.long()[:, None]
    n_cells = torch.zeros((), dtype=torch.int64, device=dev)
    # the results by input pair; orig maps the stepped pairs to it
    res = torch.zeros((P, 6), dtype=I32, device=dev)
    orig = torch.arange(P, device=dev)

    def results():
        return torch.stack([mx, max_j + 1, max_i + 1, max_ie + 1, gscore,
                            max_off], 1)

    us_e = us * e_ins
    c1 = (us[:, 1:] - 1) * e_ins
    up1 = (us + 1)[:, :-1]         # last non-zero slot + 1, by amax
    far = (F + 1 - us)[:, :-1]     # F + 1 - first non-zero slot, by amax
    TB = 64                        # rows of target codes per gather
    t0, tcode = -TB, None
    tmin = int(tlen.min()) if P else 0
    qmin = int(qlen.min()) if P else 0
    stop = tlen <= 0
    for i in range(min(Tmax, int(tlen.max()) if P else 0)):
        if bool(stop.any()):
            # cut the state to the live pairs: the others' are final
            res.index_copy_(0, orig, results())
            keep = (~stop).nonzero()[:, 0]
            if not len(keep):
                break
            (orig, H, E, qlen, tlen, toff, tdir, h0i, hent, w, w1, mx,
             max_i, max_j, max_ie, gscore, max_off, beg, end) = (
                x.index_select(0, keep) for x in (
                    orig, H, E, qlen, tlen, toff, tdir, h0i, hent, w, w1,
                    mx, max_i, max_j, max_ie, gscore, max_off, beg, end))
            qwin = qwin[:, i - q0:].index_select(0, keep)
            q0 = i
            if tcode is not None:
                tcode = tcode.index_select(0, keep)
            Hn, En = torch.empty_like(H), torch.empty_like(E)
            tmin, qmin = int(tlen.min()), int(qlen.min())
        if i - t0 == TB:
            rows = torch.arange(i, i + TB, device=dev)
            tcode = take_ref(ref, toff + tdir * rows, ref_packed).clamp_(
                max=4).long().mul_(6)
            t0 = i
        beg_r = torch.maximum(beg, i - w)
        end_r = torch.minimum(end, w1 + i)       # end <= qlen
        if cells is not None:
            n_cells += (end_r - beg_r).clamp_(min=0).sum()
        off = i - Wh - 1              # the column of slot 0
        lo = (beg_r - off)[:, None]   # band slots [lo, hi), end slot hi
        hi = (end_r - off)[:, None]
        a1 = us - (lo - 1)
        hu = hi - us
        band = torch.minimum(a1, hu).clamp_(0, 1)
        wr = torch.minimum(a1, hu + 1).clamp_(0, 1)       # [lo, hi]
        s_ij = tab.take(tcode[:, i - t0:i - t0 + 1]
                        + qwin[:, i - q0:i - q0 + F])
        # M: the diagonal input (no restart through a zero H)
        Mv = (H + s_ij).mul_(H.sign())
        # F: prefix max of (M - oe_ins)+ + u*e_ins over the band (0
        # outside it), less (u-1)*e_ins: F's gap runs from 0 in the
        # scalar kernel, and E >= 0 covers an F <= 0
        u = (Mv - oe_ins).clamp_(min=0).add_(us_e).mul_(band)
        cm = torch.cummax(u, 1).values
        hv = torch.maximum(Mv, E)
        torch.maximum(hv[:, 1:], cm[:, :-1] - c1, out=hv[:, 1:])
        hv.mul_(band)
        # row max with the rightmost-tie rule
        m = hv.amax(1)
        mj = (F - 1 + off) - hv.flip(1).argmax(1).to(I32)
        h1_0 = 0
        if i <= wmax:
            h1_0 = torch.where(
                beg_r == 0, (h0i - (o_del + e_del * (i + 1))).clamp(min=0),
                0)

        # the row's writes, straight into the row-(i+1) frame, whose slot
        # u is row-i slot u+1: H(i, j-1) at columns beg_r..end_r (h1_0 at
        # beg_r), E(i+1, j) in the band and 0 at end_r, the rest unchanged
        H1, E1 = H[:, 1:], E[:, 1:]
        torch.add(H1, (hv[:, :-1] - H1).mul_(wr[:, 1:]), out=Hn[:, :-1])
        Enew = torch.maximum(E - e_del, (Mv - oe_del).clamp_(min=0))
        torch.add(E1, (Enew[:, 1:] - E1).mul_(band[:, 1:]), out=En[:, :-1])
        bi = (lo - 1).clamp(0, F - 2).long()
        h1c = h1_0[:, None] if i <= wmax else 0
        Hn.scatter_(1, bi, torch.where(lo <= hi, h1c, Hn.gather(1, bi)))
        En.scatter_(1, (hi - 1).clamp(0, F - 2).long(), 0)
        # the entering column: row-0 fresh
        if i < n_ent:
            Hn[:, F - 1] = torch.where(qlen >= i + Wh + 2,
                                       (hent - i * e_ins).clamp(min=0), 0)
        else:
            Hn[:, F - 1] = 0
        En[:, F - 1] = 0

        # gscore bookkeeping when the row spans the full query (end_r ==
        # qlen needs i + w + 1 >= qlen): h1 at the band end, hv at column
        # end_r - 1
        if i + wmax + 1 >= qmin:
            h1_end = torch.where(end_r > beg_r, hv.gather(
                1, (hi - 1).clamp(0, F - 1).long())[:, 0], h1_0)
            full = end_r == qlen
            max_ie.masked_fill_(full & (gscore <= h1_end), i)
            gscore = torch.where(full, torch.maximum(gscore, h1_end),
                                 gscore)

        # termination + max update + zdrop
        stop = m == 0
        upd = m > mx
        max_off = torch.where(upd, torch.maximum(max_off, (mj - i).abs()),
                              max_off)
        if zdrop > 0:
            dd = (i - max_i) - (mj - max_j)
            t = mx - m
            zd = torch.where(dd > 0, t - dd * e_del, t + dd * e_ins) > zdrop
            stop = stop | (zd & ~upd)
        mx = torch.where(upd, m, mx)
        max_i.masked_fill_(upd, i)
        max_j = torch.where(upd, mj, max_j)
        if i + 1 >= tmin:             # the pairs whose last row this was
            stop = stop | (tlen <= i + 1)

        # band shrink to the non-zero region (bandedSWA.cpp:218-221): the
        # first non-zero column of [beg_r, end_r), the last of [beg_r,
        # end_r], over the written cells (next-frame slot u: column
        # off + 1 + u); with no non-zero cell, beg = end_r
        nz = (Hn[:, :-1] | En[:, :-1]).sign_()
        fs = (nz * band[:, 1:]).mul_(far).amax(1)
        beg = torch.minimum((F + 2 + off) - fs, end_r)
        ls = nz.mul_(wr[:, 1:]).mul_(up1).amax(1)
        end = torch.minimum(torch.where(ls > 0, ls + (off + 2), beg_r + 1),
                            qlen)
        H, Hn = Hn, H
        E, En = En, E
    if cells is not None:
        cells.append(int(n_cells))
    return res.index_copy_(0, orig, results())


class DeviceBSW:
    """Bucketed device dispatch for the extension pairs.

    `encj`, the chunk's padded read grid on the backend's device, and
    `lens`, each read's length on it (0 for a read the grid does not hold),
    are attached per thread by the backend: pipeline workers process whole
    chunks concurrently, each with its own read grid."""

    def __init__(self, dfm, opt):
        self.dfm = dfm
        self.max_sc = max(max(opt.mat), 0)     # as the native kernel
        self._tls = threading.local()

    @property
    def encj(self):
        return getattr(self._tls, "encj", None)

    @encj.setter
    def encj(self, v):
        self._tls.encj = v

    @property
    def lens(self):
        return getattr(self._tls, "lens", None)

    @lens.setter
    def lens(self, v):
        self._tls.lens = v

    def run_arrays(self, desc: dict, w: int, opt, end_bonus: int
                   ) -> np.ndarray:
        """Array-driven dispatch for the native extension stage
        (hostrt.extension_batch): every pair is in-cap (qlen <= QCAP,
        tlen <= TCAP), descriptors arrive as flat numpy arrays.  qoff is
        read-local; the read-grid row base is added here."""
        out = np.zeros((len(desc["qoff"]), 6), np.int32)
        flights = self._enqueue_arrays(desc, np.arange(len(out)), w, opt,
                                       end_bonus)
        return self._fetch(flights, out)

    @staticmethod
    def _fetch(flights, out: np.ndarray) -> np.ndarray:
        """One fetch of every enqueued launch's rows into out."""
        if flights:
            res = torch.cat([r for _, r in flights]).cpu().numpy()
            pos = 0
            for idxs, r in flights:
                out[idxs] = res[pos:pos + len(idxs)]
                pos += r.shape[0]
        return out

    @staticmethod
    def launch_order(qls: np.ndarray, tls: np.ndarray) -> list:
        """The rung groups of t_classes, each as (longest query, T, pair
        indices by descending (tlen, qlen), ties in descriptor order): the
        order the kernel runs them in, so that the lane groups of a warp
        and neighbouring warps run rows of similar count."""
        out = []
        for _, T, idxs in t_classes(qls, tls, np.arange(len(qls))):
            idxs = idxs[np.lexsort((-qls[idxs], -tls[idxs]))]
            out.append((int(qls[idxs].max()), T, idxs))
        return out

    @staticmethod
    def long_order(qls: np.ndarray, tls: np.ndarray, w: int,
                   fit: np.ndarray) -> tuple:
        """(pair indices, their row counts min(tlen, qlen + w + 2)) in the
        order of a call's bsw_shear launches: the pairs that fit 16 bits
        (`fit`) first, each part by descending row count, ties in
        descriptor order, so that each launch starts its longest pairs
        first."""
        rows = long_rows(qls, tls, w)
        idxs = long_first(torch.from_numpy(np.asarray(fit, bool)),
                          torch.from_numpy(rows)).numpy()
        return idxs, rows[idxs]

    def _put(self, desc: dict, idxs: np.ndarray):
        """The descriptors of pairs idxs on the grid's device: qoff (the
        flat grid offset), qdir, qlen, toff, tdir, tlen, h0."""
        dev = self.encj.device
        L = self.encj.shape[1]
        qoff = desc["seqid"][idxs].astype(np.int64) * L + desc["qoff"][idxs]

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

        return (put(qoff, np.int32), *(
            put(desc[k][idxs], dt) for k, dt in (
                ("qdir", np.int32), ("qlen", np.int32), ("toff", np.int64),
                ("tdir", np.int32), ("tlen", np.int32), ("h0", np.int32))))

    def _enqueue_arrays(self, desc: dict, sel: np.ndarray, w: int, opt,
                        end_bonus: int) -> list:
        """Launch bsw_extend on the in-cap pairs sel, one launch per rung
        group; returns [(pair indices, result rows)]."""
        from .bsw_cuda import bsw_extend
        flights = []
        if not len(sel):
            return flights
        # Q, the group's longest query, sizes the kernel's lanes
        for Q, T, idxs in self.launch_order(desc["qlen"][sel],
                                            desc["tlen"][sel]):
            idxs = sel[idxs]
            res = bsw_extend(
                self.dfm.ref, self.encj, *self._put(desc, idxs),
                torch.full((len(idxs),), w, dtype=I32,
                           device=self.encj.device), Q, T,
                *opt.mat_scores(), opt.o_del, opt.e_del, opt.o_ins,
                opt.e_ins, opt.zdrop, end_bonus, self.max_sc,
                self.dfm.ref_packed)
            flights.append((idxs, res))
        return flights

    def _enqueue_long(self, desc: dict, sel: np.ndarray, w: int, opt,
                      end_bonus: int) -> list:
        """Launch bsw_shear on the long pairs sel at the band radius Wh = w
        and the row cap of the longest pair: one launch for the pairs that
        fit 16 bits (BswShear.fits16), one for the rest, each longest
        first (long_order); returns [(pair indices, result rows)]."""
        from .bsw_shear_cuda import bsw_shear
        if not len(sel):
            return []
        qls = desc["qlen"][sel]
        scores = (*opt.mat_scores(), opt.o_del, opt.e_del, opt.o_ins,
                  opt.e_ins)
        fit = bsw_shear.fits16(qls, desc["h0"][sel], w, *scores,
                               self.max_sc)
        order, rows = self.long_order(qls, desc["tlen"][sel], w, fit)
        idxs = sel[order]
        res = bsw_shear(
            self.dfm.ref, self.encj, *self._put(desc, idxs),
            torch.full((len(idxs),), w, dtype=I32, device=self.encj.device),
            w, int(rows.max()), *scores, opt.zdrop, end_bonus, self.max_sc,
            self.dfm.ref_packed, n16=int(fit.sum()))
        return [(idxs, res)]

    def _run(self, pending, w: int, opt, end_bonus: int) -> np.ndarray:
        """Score the object path's pending pairs (align/extend.py:_Pair):
        in-cap pairs on bsw_extend, long ones on bsw_shear, every launch
        enqueued before one fetch.  A pair whose query the read grid does
        not hold (its read is longer than the grid takes) runs on the
        native host kernel, materialized, and is counted as
        overflow.bsw_host_tail; no other pair goes there."""
        if self.encj is None or self.lens is None:
            raise RuntimeError("DeviceBSW: no read grid attached on this "
                               "thread")
        n = len(pending)
        out = np.zeros((n, 6), np.int32)
        desc = {k: np.fromiter((getattr(p, k) for p in pending), dt, n)
                for k, dt in (("seqid", np.int64), ("qoff", np.int64),
                              ("qdir", np.int32), ("qlen", np.int32),
                              ("toff", np.int64), ("tdir", np.int32),
                              ("tlen", np.int32), ("h0", np.int32))}
        qls, tls = desc["qlen"], desc["tlen"]
        # the query's columns on its read's grid row
        gl = np.asarray(self.lens, np.int64)[desc["seqid"]]
        qo = desc["qoff"]
        on_grid = np.where(desc["qdir"] > 0, qo + qls <= gl,
                           (desc["qdir"] < 0) & (qo < gl) & (qo - qls + 1
                                                              >= 0))
        fits = (qls <= QCAP) & (tls <= TCAP)
        dev_idx = np.nonzero(on_grid & fits)[0]
        long_idx = np.nonzero(on_grid & ~fits & (qls <= LONG_QCAP))[0]
        host_idx = np.nonzero(~on_grid | (~fits & (qls > LONG_QCAP)))[0]
        from ..utils.profiling import PROF
        PROF.count("overflow.bsw_host_tail", len(host_idx), n)
        flights = (self._enqueue_arrays(desc, dev_idx, w, opt, end_bonus)
                   + self._enqueue_long(desc, long_idx, w, opt, end_bonus))
        self._fetch(flights, out)
        if len(host_idx):
            from ..align.extend import native_bsw_kernel_factory
            sub = [pending[i] for i in host_idx]
            for p in sub:
                if p.ref is None or p.qer is None:
                    raise ValueError(
                        "an unmaterialized pair reached the host kernel: "
                        f"seqid={p.seqid} qlen={p.qlen} tlen={p.tlen} (the "
                        "pipeline set device_caps for a read off the grid)")
            attr = "pen_clip5" if end_bonus == opt.pen_clip5 else "pen_clip3"
            out[host_idx] = native_bsw_kernel_factory(attr)(sub, w, opt)
        return out

    def left_kernel(self, pending, w, opt):
        return self._run(pending, w, opt, opt.pen_clip5)

    def right_kernel(self, pending, w, opt):
        return self._run(pending, w, opt, opt.pen_clip3)


def _tile_descriptors(q: torch.Tensor, t: torch.Tensor, qlen, tlen):
    """Tiles as descriptors: the q tile int[P, Qmax] becomes the read grid
    (row p's query at flat offset p*Qmax, walked forward) and the t tile
    int[P, Tmax] an unpacked genome (row p's target at p*Tmax).  Raises
    unless every qlen <= Qmax and tlen <= Tmax: at once on the CPU, and on
    the card through an assertion the device checks (torch._assert_async:
    no copy to the host, no wait)."""
    P, Qmax = q.shape
    Tmax = t.shape[1]
    if t.shape[0] != P or qlen.shape[0] != P or tlen.shape[0] != P:
        raise ValueError(f"tiles of {P} and {t.shape[0]} rows, {qlen.shape[0]}"
                         f" and {tlen.shape[0]} lengths")
    if P * max(Qmax, 1) >= 1 << 31:
        raise ValueError(f"{P} x {Qmax} query tile: the read grid's int32 "
                         "offsets take fewer than 2^31 cells")
    bad = (qlen < 0) | (qlen > Qmax) | (tlen < 0) | (tlen > Tmax)
    if q.device.type == "cpu":
        if bool(bad.any()):
            raise ValueError(f"lengths outside the ({Qmax}, {Tmax}) tiles")
    else:
        torch._assert_async(~bad.any(),
                            f"lengths outside the ({Qmax}, {Tmax}) tiles")
    dev = q.device
    row = torch.arange(P, device=dev)
    one = torch.ones(P, dtype=I32, device=dev)
    return (t.reshape(-1).to(torch.uint8), q.to(torch.int8).contiguous(),
            (row * Qmax).to(I32), one, qlen.to(I32), row * Tmax, one,
            tlen.to(I32))


def bsw_tiles(q, t, qlen, tlen, h0, w, mat_a: int, mat_b: int, o_del: int,
              e_del: int, o_ins: int, e_ins: int, zdrop: int,
              end_bonus: int, max_sc: int) -> torch.Tensor:
    """Banded SW extension over materialized tiles (bwamem2_tpu/ops/bsw.py:
    bsw_kernel, and the Pallas tile entry bsw_pallas): q int[P, Qmax]
    query codes, t int[P, Tmax] target codes (4 = N or padding), qlen <=
    Qmax, tlen <= Tmax, h0 and w int32[P].  Returns int32[P, 6]: score qle
    tle gtle gscore max_off.  The tiles go to bsw_extend as descriptors
    (its kernel on CUDA tensors, bsw_desc_ref on the CPU); Qmax is at most
    BswExtend.QMAX."""
    from .bsw_cuda import BswExtend, bsw_extend
    Qmax, Tmax = q.shape[1], t.shape[1]
    if Qmax > BswExtend.QMAX:
        raise ValueError(f"bsw_tiles: Qmax={Qmax} beyond the extension "
                         f"kernel's {BswExtend.QMAX}")
    ref, enc, *desc = _tile_descriptors(q, t, qlen, tlen)
    return bsw_extend(ref, enc, *desc, h0.to(I32), w.to(I32), Qmax, Tmax,
                      mat_a, mat_b, o_del, e_del, o_ins, e_ins, zdrop,
                      end_bonus, max_sc)



def bsw_shear_tiles(q, t, qlen, tlen, h0, w, Wh: int, mat_a: int,
                    mat_b: int, o_del: int, e_del: int, o_ins: int,
                    e_ins: int, zdrop: int, end_bonus: int,
                    max_sc: int) -> torch.Tensor:
    """Sheared-band extension over materialized tiles (bwamem2_tpu/ops/
    bsw.py:bsw_shear_kernel): q int[P, Qmax] query codes, t int[P, Tmax]
    target codes (4 = N or padding), qlen <= Qmax, tlen <= Tmax, h0 and w
    int32[P], Wh the band radius (at least every pair's clamped w).
    Returns int32[P, 6]: score qle tle gtle gscore max_off.  The tiles go
    to bsw_shear as descriptors (its kernels on CUDA tensors,
    bsw_shear_desc_ref on the CPU) in the order of an extension call's
    launches (tile_long_order, DeviceBSW.long_order's on the device: the
    pairs that fit 16 bits first, each part by descending rows), and the
    rows come back in tile order.  Nothing here waits for the card: the
    order and the 16-bit count stay on it (bsw_shear reads the count
    there), the row cap is the tile's width, and the lengths are checked
    by a device assertion."""
    from .bsw_shear_cuda import BswShear, bsw_shear
    ref, enc, *desc = _tile_descriptors(q, t, qlen, tlen)
    h0 = h0.to(I32)
    order, n16 = tile_long_order(desc[2], desc[5], h0, Wh, mat_a, mat_b,
                                 o_del, e_del, o_ins, e_ins, max_sc)
    if Wh > BswShear.REG_WH_MAX:     # the memory frame: every pair int32
        n16 = 0
    res = bsw_shear(ref, enc, *(x[order] for x in desc), h0[order],
                    w.to(I32)[order], Wh, t.shape[1], mat_a, mat_b, o_del,
                    e_del, o_ins, e_ins, zdrop, end_bonus, max_sc,
                    n16=n16 if q.device.type == "cuda" else 0)
    out = torch.empty_like(res)
    out[order] = res
    return out


def tile_long_order(qlen: torch.Tensor, tlen: torch.Tensor,
                    h0: torch.Tensor, Wh: int, mat_a: int, mat_b: int,
                    o_del: int, e_del: int, o_ins: int, e_ins: int,
                    max_sc: int) -> tuple:
    """DeviceBSW.long_order on tensors, on their device (no copy to the
    host): (pair indices, int64, in launch order: the pairs that fit 16
    bits (BswShear.fits16_t) first, each part by descending rows min(tlen,
    qlen + Wh + 2), ties in index order; how many fit, an int32 tensor of
    one element)."""
    from .bsw_shear_cuda import BswShear
    fit = BswShear.fits16_t(qlen, h0, Wh, mat_a, mat_b, o_del, e_del, o_ins,
                            e_ins, max_sc)
    rows = torch.minimum(tlen.to(torch.int64), qlen.to(torch.int64) + Wh + 2)
    return long_first(fit, rows), fit.sum(dtype=torch.int32).reshape(1)


def long_first(fit: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Pair indices in the order of a call's bsw_shear launches: the pairs
    that fit 16 bits first, each part by descending rows, ties in index
    order (one key, the 16-bit pairs' below the rest's, in a stable sort);
    on the tensors' device."""
    key = (~fit).to(torch.int64) * (1 << 40) - rows.to(torch.int64)
    return torch.sort(key, stable=True).indices
