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

`DeviceBSW.run_arrays` is the dispatch the native extension stage calls
(hostrt.extension_batch): pairs split over the fixed (Q, T) shape ladder,
every rung group goes, longest pairs first, to `bsw_cuda.bsw_extend` — the
CUDA kernel for a read grid on the GPU, this reference for one on the CPU
— and all groups are enqueued before one fetch.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .device_index import take_ref

I32 = torch.int32
NEG_BIG = -(1 << 30)

# hard caps: pairs beyond this go to the host kernel (the reference's
# scalar tail class); actual tile dims are the batch maxima rounded up
QCAP, TCAP = 256, 608
# long class (pacbio/ont2d) of the JAX package's sheared-band kernel; the
# port runs those pairs on the host kernel until that kernel is ported
LONG_QCAP = 32768


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


class DeviceBSW:
    """Bucketed device dispatch for the extension pairs.

    `encj`, the chunk's padded read grid on the backend's device, is
    attached per thread by the backend: pipeline workers process whole
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

    def run_arrays(self, desc: dict, w: int, opt, end_bonus: int
                   ) -> np.ndarray:
        """Array-driven dispatch for the native extension stage
        (hostrt.extension_batch): every pair is in-cap (qlen <= QCAP,
        tlen <= TCAP), descriptors arrive as flat numpy arrays.  qoff is
        read-local; the read-grid row base is added here."""
        flights, out = self._enqueue_arrays(desc, w, opt, end_bonus)
        if flights:
            res = torch.cat([r for _, r in flights]).cpu().numpy()  # 1 fetch
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

    def _enqueue_arrays(self, desc: dict, w: int, opt, end_bonus: int):
        from .bsw_cuda import bsw_extend
        encj = self.encj
        dev = encj.device
        L = encj.shape[1]
        n = len(desc["qoff"])
        out = np.zeros((n, 6), np.int32)
        qls = desc["qlen"]
        tls = desc["tlen"]
        qoff_flat = desc["seqid"].astype(np.int64) * L + desc["qoff"]
        flights = []   # all rung groups enqueued before ONE fetch
        # Q, the group's longest query, sizes the kernel's lanes
        for Q, T, idxs in self.launch_order(qls, tls):
            def put(a, dt):
                return torch.from_numpy(
                    np.ascontiguousarray(a[idxs], dt)).to(dev)

            res = bsw_extend(
                self.dfm.ref, encj, put(qoff_flat, np.int32),
                put(desc["qdir"], np.int32), put(qls, np.int32),
                put(desc["toff"], np.int64), put(desc["tdir"], np.int32),
                put(tls, np.int32), put(desc["h0"], np.int32),
                torch.full((len(idxs),), w, dtype=I32, device=dev), Q, T,
                *opt.mat_scores(), opt.o_del, opt.e_del, opt.o_ins,
                opt.e_ins, opt.zdrop, end_bonus, self.max_sc,
                self.dfm.ref_packed)
            flights.append((idxs, res))
        return flights, out
