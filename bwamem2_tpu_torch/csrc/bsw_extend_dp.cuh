// Per-pair banded Smith-Waterman extension (ksw_extend2 semantics), the
// body of the bsw_extend CUDA kernel (bsw_extend.cu).
//
// Behavioral spec: bandedSWA.cpp:116-237, as in the port's scalar host
// kernel (native/core.cpp:bsw_extend) with two differences that keep it
// identical to the descriptor kernels of the JAX package and to
// ops/bsw.py:bsw_desc_ref:
//   * q and t are gathered from descriptors (read grid `enc`, doubled
//     genome `ref`), with out-of-range positions clamped as take_ref does;
//   * the score is arithmetic (match a, mismatch -b, any N -1), the
//     structure bwa_fill_scmat always gives, and max_sc is passed in.
//
// Plain C++ when BSW_HD is defined empty, so the host tests compile this
// exact code with g++ and hold it against the PyTorch reference.

#pragma once

#include <math.h>
#include <stdint.h>

#ifndef BSW_HD
#define BSW_HD __host__ __device__ __forceinline__
#endif

struct BswParams {
    int a, b, o_del, e_del, o_ins, e_ins, zdrop, end_bonus, max_sc;
};

// Doubled-genome char at pos (ops/device_index.py:take_ref): clipped when
// unpacked; 4 chars per byte, LSB first, when packed.
BSW_HD int bsw_ref_at(const uint8_t *ref, int64_t n_ref, int packed,
                      int64_t pos) {
    if (!packed) {
        pos = pos < 0 ? 0 : (pos > n_ref - 1 ? n_ref - 1 : pos);
        return ref[pos];
    }
    int64_t b = pos >> 2;
    b = b < 0 ? 0 : (b > n_ref - 1 ? n_ref - 1 : b);
    return (ref[b] >> ((int)(pos & 3) * 2)) & 3;
}

// H and E are this pair's rows of the [Qmax+1][P] scratch: column j lives
// at H[j * stride].  out receives score qle tle gtle gscore max_off.
BSW_HD void bsw_pair(const int8_t *enc, int64_t n_enc, const uint8_t *ref,
                     int64_t n_ref, int packed, int64_t qoff, int qdir,
                     int qlen, int64_t toff, int tdir, int tlen, int h0,
                     int w, const BswParams &sp, int *H, int *E,
                     int64_t stride, int *out) {
    const int oe_del = sp.o_del + sp.e_del, oe_ins = sp.o_ins + sp.e_ins;

    // first row (bandedSWA.cpp:139-146): H[j] = max(h0-oe_ins-(j-1)e_ins, 0)
    H[0] = h0;
    E[0] = 0;
    for (int j = 1; j <= qlen; ++j) {
        int v = h0 - oe_ins - (j - 1) * sp.e_ins;
        H[j * stride] = v > 0 ? v : 0;
        E[j * stride] = 0;
    }

    // clamp the band in double, exactly as bsw.py:121-126
    int max_ins = (int)floor(
        (double)(qlen * sp.max_sc + sp.end_bonus - sp.o_ins) / sp.e_ins + 1.0);
    int max_del = (int)floor(
        (double)(qlen * sp.max_sc + sp.end_bonus - sp.o_del) / sp.e_del + 1.0);
    max_ins = max_ins > 1 ? max_ins : 1;
    max_del = max_del > 1 ? max_del : 1;
    w = w < max_ins ? w : max_ins;
    w = w < max_del ? w : max_del;

    int max = h0, max_i = -1, max_j = -1, max_ie = -1, gscore = -1;
    int max_off = 0, beg = 0, end = qlen;
    for (int i = 0; i < tlen; ++i) {
        int f = 0, h1, row_m = 0, mj = -1;
        const int ti = bsw_ref_at(ref, n_ref, packed, toff + (int64_t)tdir * i);
        if (beg < i - w) beg = i - w;
        if (end > i + w + 1) end = i + w + 1;
        if (end > qlen) end = qlen;
        if (beg == 0) {
            h1 = h0 - (sp.o_del + sp.e_del * (i + 1));
            if (h1 < 0) h1 = 0;
        } else {
            h1 = 0;
        }
        int j = beg;
        for (; j < end; ++j) {
            // H[j] holds H(i-1,j-1); E[j] holds E(i,j); f = F(i,j);
            // h1 = H(i,j-1)
            int64_t qp = qoff + (int64_t)qdir * j;
            qp = qp < 0 ? 0 : (qp > n_enc - 1 ? n_enc - 1 : qp);
            const int qj = enc[qp];
            const int sc = (ti >= 4 || qj >= 4) ? -1
                           : (ti == qj ? sp.a : -sp.b);
            int M = H[j * stride], e = E[j * stride];
            H[j * stride] = h1;              // H(i,j-1) for the next row
            M = M ? M + sc : 0;              // no restart through zero H
            int h = M > e ? M : e;
            h = h > f ? h : f;
            h1 = h;
            mj = row_m > h ? mj : j;         // rightmost tie wins
            row_m = row_m > h ? row_m : h;
            int t = M - oe_del;
            t = t > 0 ? t : 0;
            e -= sp.e_del;
            e = e > t ? e : t;
            E[j * stride] = e;
            t = M - oe_ins;
            t = t > 0 ? t : 0;
            f -= sp.e_ins;
            f = f > t ? f : t;
        }
        H[end * stride] = h1;
        E[end * stride] = 0;
        if (j == qlen) {                     // reached the end of the query
            max_ie = gscore > h1 ? max_ie : i;
            gscore = gscore > h1 ? gscore : h1;
        }
        if (row_m == 0) break;
        if (row_m > max) {
            max = row_m, max_i = i, max_j = mj;
            int off = mj > i ? mj - i : i - mj;
            max_off = max_off > off ? max_off : off;
        } else if (sp.zdrop > 0) {
            if (i - max_i > mj - max_j) {
                if (max - row_m - ((i - max_i) - (mj - max_j)) * sp.e_del
                    > sp.zdrop) break;
            } else {
                if (max - row_m - ((mj - max_j) - (i - max_i)) * sp.e_ins
                    > sp.zdrop) break;
            }
        }
        // shrink the band to the non-zero region
        for (j = beg; j < end && H[j * stride] == 0 && E[j * stride] == 0; ++j) {}
        beg = j;
        for (j = end; j >= beg && H[j * stride] == 0 && E[j * stride] == 0; --j) {}
        end = j + 2 < qlen ? j + 2 : qlen;
    }
    out[0] = max;
    out[1] = max_j + 1;
    out[2] = max_i + 1;
    out[3] = max_ie + 1;
    out[4] = gscore;
    out[5] = max_off;
}
