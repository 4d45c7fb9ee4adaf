// Two-phase striped local Smith-Waterman for one mate-rescue problem, the
// body of the kswv CUDA kernel (kswv.cu).
//
// Behavioral spec: ksw_align with KSW_XSUBO | KSW_XSTART (ksw.cpp:347-381),
// as the port's scalar host kernel emulates it lane for lane
// (native/core.cpp: ksw_run_u8 :397-505, ksw_run_i16 :507-612, ksw_align
// :631-655).  The loops below are those functions' loops: NL = 16 u8 lanes
// (biased by shift = -min(mat), adds saturating at 255, subtracts at 0) or
// NL = 8 i16 lanes (raw signed adds), slen = ceil(qlen/NL) segments, the
// main pass with intra-stripe F, up to 16 lazy-F sweeps, the row maximum
// taken before the fixup and Hmax copied after it.  Three differences keep
// it identical to bwamem2_tpu/ops/kswv.py:kswv_two_phase and to
// ops/kswv.py:kswv_two_phase_ref, the outputs it is held against:
//   * q and t are gathered from descriptors (read grid `enc`, doubled genome
//     `ref` through bsw_ref_at), and the profile is computed per cell: pad
//     columns score 0, ambiguous bases -1, else a / -b.  No qp table;
//   * each phase writes (score, te, qe, score2, te2, saturated); qe, score2
//     and te2 are also computed for saturated u8 lanes (the caller masks
//     them), and qe is -1 when no row scored;
//   * phase 1 walks the reversed prefixes of exactly te+1 target bases.
//
// Plain C++ when BSW_HD is defined empty, so the host tests compile this
// exact code with g++ and hold it against the PyTorch reference.

#pragma once

#include "bsw_extend_dp.cuh"

#ifdef __CUDACC__
#define KSWV_UNROLL _Pragma("unroll")
#else
#define KSWV_UNROLL
#endif

#define KSWV_NO_LIMIT 0x10000   // endsc / minsc meaning "none"

struct KswvParams {
    int a, b, o_del, e_del, o_ins, e_ins;
};

// One phase's problem: the query walk in the read grid, the target walk in
// the doubled genome, the stop score, the b-array floor and whether to run.
struct KswvDesc {
    int64_t qoff;
    int qdir, qcomp, qlen;
    int64_t toff;
    int tdir, tlen, endsc, minsc, live;
};

// This problem's column of the kernel's scratch: cell c of H0/H1/E/Hmax
// (c = segment * NL + lane) lives at ptr[c * stride], row i's maximum at
// rowmax[i * stride].
struct KswvScratch {
    int *H0, *H1, *E, *Hmax;
    int16_t *rowmax;
    int64_t stride;
};

BSW_HD int kswv_max(int x, int y) { return x > y ? x : y; }

// One phase; qcap/tcap bound qlen/tlen to the scratch (qcap a multiple of
// 16).  out receives score te qe score2 te2 saturated.
template <int NL, bool U8>
BSW_HD void kswv_phase(const int8_t *enc, int64_t n_enc, const uint8_t *ref,
                       int64_t n_ref, int packed, const KswvDesc &d,
                       const KswvParams &sp, int qcap, int tcap,
                       KswvScratch s, int *out) {
    const int64_t st = s.stride;
    const int shift = sp.b > 1 ? sp.b : 1;
    const int maxsc = sp.a > 1 ? sp.a : 1;
    const int oe_del = sp.o_del + sp.e_del, oe_ins = sp.o_ins + sp.e_ins;
    const int qlen = d.qlen < qcap ? d.qlen : qcap;
    const int tlen = d.tlen < tcap ? d.tlen : tcap;
    const int slen = (qlen + NL - 1) / NL;
    const int ncell = slen * NL;
    int *H0 = s.H0, *H1 = s.H1, *E = s.E, *Hmax = s.Hmax;
    for (int c = 0; c < ncell; ++c) {
        H0[c * st] = 0;
        E[c * st] = 0;
    }
    int gmax = 0, te = -1, rowstop = d.live ? tlen : 0;
    for (int i = 0; d.live && i < tlen; ++i) {
        const int ti =
            bsw_ref_at(ref, n_ref, packed, d.toff + (int64_t)d.tdir * i);
        int f[NL], maxv[NL], h[NL];
        // h = H0's last segment shifted up one lane
        h[0] = 0;
        KSWV_UNROLL
        for (int l = 0; l < NL; ++l) {
            f[l] = 0;
            maxv[l] = 0;
            if (l && slen) h[l] = H0[((slen - 1) * NL + l - 1) * st];
        }
        for (int j = 0; j < slen; ++j) {
            KSWV_UNROLL
            for (int l = 0; l < NL; ++l) {
                const int c = l * slen + j;            // query column
                const int64_t cell = (int64_t)(j * NL + l) * st;
                int sc = 0;                            // pad column
                if (c < qlen) {
                    int64_t qp = d.qoff + (int64_t)d.qdir * c;
                    qp = qp < 0 ? 0 : (qp > n_enc - 1 ? n_enc - 1 : qp);
                    int qc = enc[qp];
                    if (d.qcomp && qc < 4) qc = 3 - qc;
                    sc = (ti >= 4 || qc >= 4) ? -1 : (ti == qc ? sp.a : -sp.b);
                }
                int hh = h[l] + sc;
                if (U8) {       // subsu8(addsu8(h, sc + shift), shift)
                    hh += shift;
                    hh = (hh < 255 ? hh : 255) - shift;
                    hh = kswv_max(hh, 0);
                }
                const int ee = E[cell];
                hh = kswv_max(kswv_max(hh, ee), f[l]);
                maxv[l] = kswv_max(maxv[l], hh);
                H1[cell] = hh;
                E[cell] = kswv_max(kswv_max(ee - sp.e_del, 0),
                                   kswv_max(hh - oe_del, 0));
                f[l] = kswv_max(kswv_max(f[l] - sp.e_ins, 0),
                                kswv_max(hh - oe_ins, 0));
            }
            KSWV_UNROLL
            for (int l = 0; l < NL; ++l) h[l] = H0[(j * NL + l) * st];
        }
        // lazy-F: carry F across the stripe boundaries, one lane a sweep
        bool done = false;
        for (int k = 0; k < 16 && !done; ++k) {
            KSWV_UNROLL
            for (int l = NL - 1; l > 0; --l) f[l] = f[l - 1];
            f[0] = 0;
            for (int j = 0; j < slen; ++j) {
                bool all_le = true;
                KSWV_UNROLL
                for (int l = 0; l < NL; ++l) {
                    const int64_t cell = (int64_t)(j * NL + l) * st;
                    int hh = H1[cell];
                    if (f[l] > hh) {
                        hh = f[l];
                        H1[cell] = hh;
                    }
                    hh = kswv_max(hh - oe_ins, 0);
                    f[l] = kswv_max(f[l] - sp.e_ins, 0);
                    if (f[l] > hh) all_le = false;
                }
                if (all_le) {
                    done = true;
                    break;
                }
            }
        }
        int imax = 0;
        KSWV_UNROLL
        for (int l = 0; l < NL; ++l) imax = kswv_max(imax, maxv[l]);
        s.rowmax[i * st] = (int16_t)imax;
        if (imax > gmax) {
            gmax = imax;
            te = i;
            for (int c = 0; c < ncell; ++c) Hmax[c * st] = H1[c * st];
            if ((U8 && gmax + shift >= 255) || gmax >= d.endsc) {
                rowstop = i + 1;
                break;
            }
        }
        int *t = H0;
        H0 = H1;
        H1 = t;
    }

    const int sat = U8 && d.live && gmax + shift >= 255;
    const int score = sat ? 255 : gmax;
    // qe: the least query column among the Hmax maxima, pad columns
    // included, scanned in the striped order (column c / NL + c % NL * slen)
    int qe = -1;
    if (d.live && te >= 0) {
        int mx = -1;
        for (int c = 0; c < ncell; ++c) {
            const int v = Hmax[c * st], pos = c / NL + c % NL * slen;
            if (v > mx || (v == mx && pos < qe)) {
                mx = v;
                qe = pos;
            }
        }
    }
    // second best from the b-array: an entry merges only into the entry of
    // the immediately preceding row; the first best outside te +-
    // ceil(score / maxsc) wins
    int best2 = -1, te2 = -1;
    if (d.minsc <= 0xFFFF && d.live) {
        const int i2 = (score + maxsc - 1) / maxsc;
        const int low = te - i2, high = te + i2;
        bool have = false;
        int val = 0, row = -2;
        for (int i = 0; i < rowstop; ++i) {
            const int rm = s.rowmax[i * st];
            if (rm < d.minsc) continue;
            if (have && row + 1 == i) {
                if (rm > val) val = rm, row = i;
                continue;
            }
            if (have && (row < low || row > high) && val > best2)
                best2 = val, te2 = row;
            val = rm, row = i, have = true;
        }
        if (have && (row < low || row > high) && val > best2)
            best2 = val, te2 = row;
    }
    out[0] = score;
    out[1] = te;
    out[2] = qe;
    out[3] = best2;
    out[4] = te2;
    out[5] = sat;
}

// Both phases of one problem: phase 0 forward with the b-array floor
// minsc, then phase 1 on the reversed prefixes that end at the phase-0 end,
// stopping at the phase-0 score, when phase 0 found a score >= minsc that
// did not saturate.  out0/out1 receive the two rows of 6.
template <int NL, bool U8>
BSW_HD void kswv_problem(const int8_t *enc, int64_t n_enc, const uint8_t *ref,
                         int64_t n_ref, int packed, int64_t qoff, int qdir,
                         int qcomp, int qlen, int64_t toff, int tlen,
                         int minsc, const KswvParams &sp, int qcap, int tcap,
                         KswvScratch s, int *out0, int *out1) {
    const KswvDesc d0{qoff,  qdir, qcomp,         qlen,  toff,
                      1,     tlen, KSWV_NO_LIMIT, minsc, 1};
    kswv_phase<NL, U8>(enc, n_enc, ref, n_ref, packed, d0, sp, qcap, tcap, s,
                       out0);
    const int score = out0[0], te = out0[1], qe = out0[2];
    const int want = out0[5] == 0 && score >= minsc && te >= 0 && qe >= 0;
    const KswvDesc d1{qoff + (int64_t)qdir * qe, -qdir, qcomp,
                      want ? qe + 1 : 0,         toff + te,
                      -1,                        want ? te + 1 : 0,
                      score,                     KSWV_NO_LIMIT,
                      want};
    kswv_phase<NL, U8>(enc, n_enc, ref, n_ref, packed, d1, sp, qcap, tcap, s,
                       out1);
}
